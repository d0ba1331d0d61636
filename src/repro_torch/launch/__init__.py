"""Entry points of the LM substrate (serving)."""
