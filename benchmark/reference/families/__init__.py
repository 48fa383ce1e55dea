"""The segmentation families, one module each, found by a configuration's
``model`` (``reference/__init__.py`` states what a module defines)."""
