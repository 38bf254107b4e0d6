"""Attention over the sequence axis; ring and Ulysses come later."""
