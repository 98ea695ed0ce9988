"""Many files per device step: parallel/batch.py (file lanes on one card)."""
