"""Input data: synthetic scenes, materialized shards, the KITTI and
SYNTHIA readers, and the batch stream with its prefetch thread."""
