"""Plain PyTorch and NumPy reference of what the benchmark's cells run;
it imports nothing of the program under test."""
