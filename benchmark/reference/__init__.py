"""The plain reference: the cells' input generators and an LZ4 block decoder.

Imports NumPy only, and nothing of the program.
"""
