"""The dense decoder (``decoder``) and the parameter layout of its
gradient buckets (``params``)."""
