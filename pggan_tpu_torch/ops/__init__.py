"""Kernel wrappers, their plain versions, and the generator's primitives."""
