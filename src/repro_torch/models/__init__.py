"""The LM side of the port: layers, the dense decoder and its Model API."""
