"""Entry points of the port: the counterparts of ``repro.launch`` — the
serving and training launchers, and the mesh (``mesh``), the input specs
(``inputs``), the variants (``variants``) and the dry run (``dryrun``)."""
