"""Substrate: feature schema, config, dataset encoding, metrics, logging,
device choice."""
