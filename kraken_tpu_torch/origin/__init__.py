"""Origin: metainfo generation for committed blobs."""
