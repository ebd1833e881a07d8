"""Grid construction for launched runs (port of ``repro.launch``; only
``mesh.make_process_grid`` so far)."""
