"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.dryrun``; the device meshes (``launch.mesh``) and the
analysis tools (``roofline``, ``analytic``, ``specs``, ``steps``)."""
