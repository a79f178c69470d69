"""Host-side helpers of the recipe: printing and seeding, HTML pages,
depth and flow colouring, ``.flo`` files, depth metrics and the batch
visualizer. Numpy and the standard library only."""
