"""Architecture configs of the port; each module registers one arch."""
