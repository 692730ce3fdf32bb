"""Entry points of the port's model stack (``serve``, ``train``) and its
mesh tooling (``mesh``: the production and debug meshes; ``dryrun``: one
step of each (arch x shape x mesh) cell on placeholder ranks)."""
