"""Model zoo: the dense decoder's serving path (``repro.models`` counterpart)."""
