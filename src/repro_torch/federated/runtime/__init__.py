"""The async federation runtime's models.

Only the latency and dropout models are ported so far (``latency.py``);
the scheduler, the buffered aggregators and ``AsyncFederation`` are not.
"""
