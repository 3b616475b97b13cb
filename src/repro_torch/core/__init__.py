"""Estimator core, aggregators, attacks, graphs and paradigm loops."""
