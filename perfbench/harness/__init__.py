"""What the harness shares between cells: inputs, work, traces."""
