"""The device scheduler (fleet/scheduler.py)."""
