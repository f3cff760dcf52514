"""The benchmark's plain reference: lifting DWT in plain PyTorch.

It imports nothing of the program under test; see :mod:`.lifting`.
"""
