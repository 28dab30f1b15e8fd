"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

``LAUNCHES`` counts kernel launches by kernel name.  Each wrapper adds one
where it launches its kernel and nowhere else (its plain-version path on
CPU tensors does not count), so a run can show that it went through the
kernels: reset the counts, drive the path, read them.
"""

from collections import Counter

LAUNCHES: Counter = Counter()
