"""Measurement scripts of the port, run on a machine with the card; each
prints what it measured with the card's name and power limit."""
