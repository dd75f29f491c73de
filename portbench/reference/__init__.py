"""The benchmark's plain reference: frozen copies of the value-context
verifier and `check.py`, which decides `correct`. Imports nothing of the
program under test."""
