"""The plain float64 reference the benchmark compares the program with."""
