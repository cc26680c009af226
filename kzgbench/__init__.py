"""The benchmark of `kzg_tpu_torch` (README.md). Importing it imports
nothing of the program."""
