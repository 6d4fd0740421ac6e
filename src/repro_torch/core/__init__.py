"""Port of ``repro.core``: the fluid simulator and the pieces it needs."""
