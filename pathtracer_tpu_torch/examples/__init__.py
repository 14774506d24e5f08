"""Example renders, each runnable as
``python -m pathtracer_tpu_torch.examples.<name> --help``."""
