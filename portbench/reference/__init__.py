"""Plain references the benchmark judges the program's answers by."""
