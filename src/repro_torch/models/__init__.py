"""Model building blocks and the attention-only transformer assembly."""
