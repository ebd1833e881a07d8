"""Training-side consumers of the collective stack."""
