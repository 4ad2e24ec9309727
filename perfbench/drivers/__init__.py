"""One module a kind of system, named by a configuration's ``driver``."""
