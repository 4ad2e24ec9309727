"""The traffic mixes (data files) and their generators (``generators/``)."""
