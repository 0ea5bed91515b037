"""Authentication evaluation: agents, the scorer and the grid."""
