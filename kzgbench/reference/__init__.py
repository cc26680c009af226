"""The plain reference: BLS12-381 in Python integers (`bls.py`), exact
arithmetic modulo r over arrays in plain PyTorch (`fr.py`), the expected
outputs (`judge.py`) and the reference in the program's place
(`system.py`). It imports nothing of the program."""
