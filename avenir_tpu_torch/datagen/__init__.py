"""Seeded synthetic data generators with planted ground truth."""

from avenir_tpu_torch.datagen.generators import (  # noqa: F401
    EVENT_SEQ_EVENTS, LeadGenSimulator, buy_xaction_rows, churn_rows,
    churn_schema, elearn_rows, elearn_schema, elearn_schema_json,
    event_seq_rows, hmm_tagged_rows, hosp_readmit_rows, hosp_readmit_schema,
    markov_sequences, price_opt_arms, retarget_rows, retarget_schema)
