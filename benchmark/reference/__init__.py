"""The plain reference that decides whether a run is correct: PyTorch
and NumPy only, importing nothing of the program under test."""
