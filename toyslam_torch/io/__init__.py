"""Graph IO: the wire codec, snapshots, the remote client and the servers."""
