"""The paper's two experimental tasks and their heterogeneous partitioning."""
