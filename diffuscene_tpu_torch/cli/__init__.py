"""Command-line entry points of the port; each runs on the card unless
``--device cpu`` is given."""
