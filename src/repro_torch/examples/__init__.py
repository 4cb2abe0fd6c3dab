"""The port's counterparts of the repository's ``examples/`` scripts, run as
``python -m repro_torch.examples.<name>`` (``--device`` defaults to cuda;
pass ``--device cpu`` to run on the CPU). Importing them runs nothing."""
