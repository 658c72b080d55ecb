"""Ray data parallelism over several devices (sharding.py)."""
