"""Router services: request proxying, rewriting, callbacks, metrics, batch,
files."""
