"""Input pipelines (port of ``repro.data``)."""
