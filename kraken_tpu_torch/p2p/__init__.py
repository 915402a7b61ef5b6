"""The P2P plane: torrent storage and batched piece verification."""
