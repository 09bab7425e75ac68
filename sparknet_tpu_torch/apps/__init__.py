"""Application drivers of the port (``apps.cifar_app``)."""
