from .checkpointer import Checkpointer, save_pytree, restore_pytree

__all__ = ["Checkpointer", "save_pytree", "restore_pytree"]
