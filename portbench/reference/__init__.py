"""Plain NumPy reference of the LASTZ semantics the benchmark checks.

It reads the configuration's own files and the generated sequences, and
imports nothing of the program under test (a test holds it to that).
"""
