"""Model layouts the port needs (the model stack itself is a later slice)."""
