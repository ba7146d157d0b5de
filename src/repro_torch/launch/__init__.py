"""The LM training path of the port: ``steps.py`` (the island step) and
``train.py`` (the async federated trainer)."""
