"""Models, re-expressed with torch ops on batched tensors."""
