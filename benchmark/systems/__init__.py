"""The systems under test, one module per ``system`` of a configuration."""
