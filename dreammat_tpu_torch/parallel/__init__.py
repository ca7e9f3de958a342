"""Process group (``distributed``) and rank mesh (``mesh``) of the port."""
