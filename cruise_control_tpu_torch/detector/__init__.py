"""Anomaly taxonomy (detector/anomalies.py)."""
