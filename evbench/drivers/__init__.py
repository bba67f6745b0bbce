"""One driver per model family, named by a configuration's ``driver``."""
