"""Command-line entry points of the port (``serve``, ``train``,
``dryrun``), the meshes (``mesh``) and the layout rules
(``sharding``)."""
