"""Plain references of what the benchmark checks; they import nothing
of the program."""
