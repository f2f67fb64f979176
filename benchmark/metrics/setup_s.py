"""The end of ``import torch`` to the window's start: the program's import,
the card, the relations, kernel builds and the warm operations."""


def read(ctx):
    return ctx.setup_s
