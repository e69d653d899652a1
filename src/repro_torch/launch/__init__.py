"""Entry points: the local mesh (``mesh``), serving (``serve``) and
training (``train``)."""
