"""Command-line drivers (``python -m avenir_tpu_torch <Verb> ...``)."""

from avenir_tpu_torch.cli import main  # noqa: F401
