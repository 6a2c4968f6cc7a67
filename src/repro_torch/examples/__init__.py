"""Runnable examples of the port, the twins of the repository's
``examples/``: each module's ``main(argv=None)`` takes ``--device``
(CUDA unless ``--device cpu``) and runs only when the module is run
(``python -m repro_torch.examples.<name>``), never on import."""
