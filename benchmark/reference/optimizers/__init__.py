"""The optimizers, one module each, found by a traffic file's
``recipe.optimizer`` (``reference/__init__.py`` states what a module defines)."""
