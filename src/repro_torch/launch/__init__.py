"""Entry points of the port: the counterparts of ``repro.launch`` (the
serving launcher so far; the training launcher waits for training, in
ROADMAP.md, "Modules still to port")."""
