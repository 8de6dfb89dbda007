"""Multi-device and multi-process execution of the port (``mesh.py``,
``sharded.py``)."""
