"""Application drivers of the port (``apps.cifar_app``, ``apps.lm_app``,
``apps.imagenet_app``)."""
