"""Plain PyTorch answers of the benchmark's operations.

Nothing here imports the program or JAX: each answer is worked out again
from the relations the benchmark made.  The ``control_*`` functions give the
same answers with one guarantee broken, to show that the comparison fails
them.
"""
