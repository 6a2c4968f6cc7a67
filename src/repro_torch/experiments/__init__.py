"""Dry-run experiments: the twins of the JAX package's ``experiments/*.py``
scripts over the port's ``launch/dryrun.run_cell``, with the same
arguments and printed lines, writing under the port's own directories
(``experiments/*_torch``).  Run each as ``python -m
repro_torch.experiments.<name>``."""
