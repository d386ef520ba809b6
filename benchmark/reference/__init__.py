"""Plain references: torch and numpy only, nothing of the program."""
