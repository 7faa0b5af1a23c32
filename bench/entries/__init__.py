"""Entries into the program, one file each, named by a traffic file's
``"entry"``.  Each defines ``Session(config, traffic, seed, device)``
whose construction lays out the relations, whose ``warm()`` runs one
request of the window's shapes, whose ``step(tracer, spans)`` serves one
request and returns ``(served, reports, answers)``, and whose
``close()`` frees the program's state."""
