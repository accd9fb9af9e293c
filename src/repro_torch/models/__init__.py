"""The model zoo of the port: counterparts of ``repro.models``."""
