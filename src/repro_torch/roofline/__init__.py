"""Roofline machinery (port of ``repro.roofline``): the H100 roofline
terms (``terms``), the work counter that takes the place of the HLO parser
(``counter``), the collectives of the production layout (``layout``) and
the dry run's tables (``report``)."""
