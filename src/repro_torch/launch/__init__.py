"""Training and serving entry points of the port (port of ``repro.launch``)."""
