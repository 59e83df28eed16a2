"""Host-side utilities of the port: PLY, GLB, PNG and mesh processing (numpy only)."""
