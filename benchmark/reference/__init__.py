"""The plain reference that decides ``correct``: NumPy (and SciPy's sparse
products) over the inputs the harness made.  It imports nothing of the
program and reads the program's outputs only to judge them."""
