"""Entry points: the local mesh (``mesh``) and serving (``serve``)."""
