"""Model building blocks and the dense, SSM and hybrid stack assembly."""
