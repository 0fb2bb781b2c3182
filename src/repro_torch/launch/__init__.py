"""Launchers of the port (``python -m repro_torch.launch.train``,
``.serve``, ``.elastic``, ``.dryrun``, ``.convert_graph``) and the mesh
machinery they share (``mesh``, ``specs``, ``ranks``, ``op_analysis``)."""
