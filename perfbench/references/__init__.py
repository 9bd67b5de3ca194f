"""Plain references, one a model family, that import nothing of the
program."""
