"""Maximal clique enumeration core of the port: host reductions and the
oracle (numpy/pure Python) and the bitset engine (`engine`, PyTorch)."""
