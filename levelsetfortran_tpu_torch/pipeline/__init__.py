"""End-to-end pipeline and command line."""
