"""Examples that the README points users to, each run with
``python -m repro_torch.examples.<name>``."""
