"""Verification harnesses (mirrors repro/testing/): the scenario checks
and the golden-trajectory harness of the simulator."""
