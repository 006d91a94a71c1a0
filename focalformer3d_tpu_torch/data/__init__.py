"""Host-side data: synthetic LiDAR scenes, the nuScenes reader, transforms
and pipelines, the native point loader and the batch prefetcher."""
