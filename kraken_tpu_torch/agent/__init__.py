"""Agent: the node's HTTP API over the P2P download plane."""
