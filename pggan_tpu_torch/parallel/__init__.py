"""Data-parallel training across processes (`mesh.py`) and its CPU dry run
(`dryrun.py`)."""
