"""Host-side data: synthetic LiDAR scenes, the nuScenes reader, transforms
and pipelines, the native point loader, the camera images' JPEG decoder and
resampler (``image_io``) and the batch prefetcher."""
