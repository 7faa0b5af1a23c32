"""Launchers (``repro.launch`` counterpart): ``serve``."""
