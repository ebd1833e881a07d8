"""Launched runs (port of ``repro.launch``): rank grids and default
sharding rules (``mesh``), every cell's abstract arguments and specs
(``specs``), and the training driver (``train``, ``python -m
repro_torch.launch.train``)."""
