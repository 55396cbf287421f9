"""The HTTP statement server over the torch engine."""
