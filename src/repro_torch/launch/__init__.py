"""Launchers (``repro.launch`` counterpart): ``serve`` and ``train``."""
