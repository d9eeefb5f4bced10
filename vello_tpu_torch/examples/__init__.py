"""The repository's example scripts (``examples/``) on the port: headless,
animation and demo, each run with ``python -m vello_tpu_torch.examples.<name>``."""
