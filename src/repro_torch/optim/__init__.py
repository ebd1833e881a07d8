"""AdamW and the tree codecs (port of ``repro.optim``)."""
