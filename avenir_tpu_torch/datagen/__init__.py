"""Seeded synthetic data generators with planted ground truth."""

from avenir_tpu_torch.datagen.generators import (  # noqa: F401
    churn_rows, churn_schema, elearn_rows, elearn_schema, elearn_schema_json)
