"""Language-model stack of the port (port of ``repro.models``): the
``ssm`` family (Mamba-2 / SSD) and the ``dense`` family (llama) so far."""
