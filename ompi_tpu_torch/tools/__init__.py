"""Measurement scripts for the port, run on the card (see each module)."""
